"""Deterministic fault injection for ``tpudp_torch.serve`` — the port of
``tpudp/serve/faults.py``'s drafter, step and token injectors, the
fixtures of the engine's robustness tests and of ``chip_smoke.py``'s
phase 4g.

Every injector is plain deterministic Python: which call fails, how and
when is fixed by its constructor arguments, so a failing run replays
exactly.  Three seams, all engine API:

  * **Drafter faults** — :class:`FailingDrafter`, :class:`SlowDrafter`
    and :class:`MalformedDrafter` are ``Engine(drafter=...)`` drafters
    that raise, stall or return garbage.  The engine must quarantine
    them (``Engine.drafter_quarantined``) without changing any output.
  * **Step faults** — :class:`FaultySteps` and :class:`SlowSteps` are
    ``Engine(step_fault_hook=...)`` callables, called as ``hook(kind,
    index)`` just before each device call (``kind`` in ``{"prefill",
    "sample", "decode", "verify", "tree_verify", "fused_decode",
    "fused_spec"}``; ``index`` counts the engine's device calls, so a
    retried call gets a new one and a one-shot fault stays one-shot).
    Raising stands for a failed step; sleeping for a wedged one, for the
    watchdog to catch.
  * **Token faults** — :class:`BitFlipLogits` is an
    ``Engine(token_fault_hook=...)`` callable, ``hook(slot, tok,
    request) -> tok`` where each token commits: it corrupts silently,
    the fault only the serving canary (``Engine(canary_every_s=...)``)
    sees.

A fourth injector drives the scheduler rather than a seam:
:class:`PreemptionStorm` submits high-priority bursts into a
tenant-aware engine on a fixed schedule, so lower-priority work is
preempted over and over.  JAX's cross-host transfer faults
(disaggregated serving) belong to a later slice (ROADMAP.md).
"""

from __future__ import annotations

import time

import numpy as np

from tpudp_torch.serve.engine import QueueFull


class InjectedFault(RuntimeError):
    """Raised by the injectors below — typed so tests can tell an
    injected failure from an organic one."""


class FailingDrafter:
    """Proposes via ``inner`` for ``ok_proposals`` calls, then raises on
    every later call — the mid-run drafter death.  ``inner=None`` makes
    the healthy calls propose nothing (still well-formed)."""

    def __init__(self, inner=None, ok_proposals: int = 0,
                 exc_type=InjectedFault):
        if ok_proposals < 0:
            raise ValueError(
                f"ok_proposals must be >= 0, got {ok_proposals}")
        self.inner = inner
        self.ok_proposals = ok_proposals
        self.exc_type = exc_type
        self.calls = 0

    def propose(self, context: np.ndarray, k: int) -> np.ndarray:
        self.calls += 1
        if self.calls > self.ok_proposals:
            raise self.exc_type(
                f"injected drafter failure (call {self.calls})")
        if self.inner is None:
            return np.zeros(0, np.int32)
        return self.inner.propose(context, k)


class SlowDrafter:
    """Valid proposals delivered after ``delay_s`` — trips
    ``Engine(drafter_timeout_s=...)``.  With ``inner=None`` it proposes
    k copies of the context's first token (in-vocab by construction), so
    the quarantine decision is purely about TIME, never content."""

    def __init__(self, delay_s: float, inner=None):
        self.delay_s = delay_s
        self.inner = inner

    def propose(self, context: np.ndarray, k: int) -> np.ndarray:
        time.sleep(self.delay_s)
        if self.inner is not None:
            return self.inner.propose(context, k)
        context = np.asarray(context, np.int32).reshape(-1)
        return np.full(max(k, 0), int(context[0]), np.int32)


class MalformedDrafter:
    """Returns structurally invalid proposals.  Modes:

    * ``"out_of_vocab"`` — ids past any real vocab size
    * ``"negative"`` — negative ids
    * ``"float"`` — non-integer dtype
    * ``"junk"`` — not coercible to a token array at all
    """

    MODES = ("out_of_vocab", "negative", "float", "junk")

    def __init__(self, mode: str = "out_of_vocab"):
        if mode not in self.MODES:
            raise ValueError(f"mode must be one of {self.MODES}, "
                             f"got {mode!r}")
        self.mode = mode

    def propose(self, context: np.ndarray, k: int):
        k = max(k, 1)
        if self.mode == "out_of_vocab":
            return np.full(k, 2 ** 31 - 1, np.int64)
        if self.mode == "negative":
            return np.full(k, -3, np.int32)
        if self.mode == "float":
            return np.full(k, 0.5, np.float32)
        return "these are not tokens"


class FaultySteps:
    """Step-raise hook: raises :class:`InjectedFault` when the device-
    call ``index`` is in ``fail_at`` (optionally restricted to one step
    ``kind``).  The hook runs before the device call, so the injected
    failure lands exactly where a real one would: inside the engine's
    step-containment region.  ``fired`` records what was injected."""

    def __init__(self, fail_at, kind: str | None = None):
        self.fail_at = set(fail_at)
        self.kind = kind
        self.fired: list[tuple[str, int]] = []

    def __call__(self, kind: str, index: int) -> None:
        if index in self.fail_at and (self.kind is None
                                      or kind == self.kind):
            self.fired.append((kind, index))
            raise InjectedFault(
                f"injected step fault at {kind} call {index}")


class SlowSteps:
    """Step-stall hook: sleeps ``delay_s`` before the configured device
    calls — a deterministic stand-in for a wedged device step, used to
    exercise ``Engine(watchdog=...)`` arming (the sleep happens inside
    the watchdog's scoped deadline)."""

    def __init__(self, stall_at, delay_s: float, kind: str | None = None):
        self.stall_at = set(stall_at)
        self.delay_s = delay_s
        self.kind = kind
        self.fired: list[tuple[str, int]] = []

    def __call__(self, kind: str, index: int) -> None:
        if index in self.stall_at and (self.kind is None
                                       or kind == self.kind):
            self.fired.append((kind, index))
            time.sleep(self.delay_s)


class PreemptionStorm:
    """Deterministic preemption pressure for a tenant-aware engine:
    submits one short request into ``tenant`` (a high-priority class)
    each time the caller's step counter reaches the next entry of
    ``at_steps``, so the scheduler evicts lower-priority in-flight slots
    through the preemption path.  Schedule, prompts and seeds are fixed
    by the constructor, so a storm that exposes a leak or a parity break
    replays exactly.

    The caller runs :meth:`tick` once per scheduler iteration (the
    storm does not hook the engine: submission timing is scheduler
    behaviour, not a device fault).  ``handles`` holds each burst's
    handle (None where the class's own ``queue_limit`` shed it);
    ``submitted`` counts the accepted ones."""

    def __init__(self, tenant: str, prompts, at_steps, max_new: int = 2,
                 seed: int = 0):
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        self.tenant = tenant
        self.prompts = [np.asarray(p, np.int32).reshape(-1)
                        for p in prompts]
        if not self.prompts:
            raise ValueError("prompts must be non-empty")
        self.at_steps = sorted(int(s) for s in at_steps)
        self.max_new = max_new
        self.seed = seed
        self.handles: list = []
        self.submitted = 0
        self._next = 0

    @property
    def done(self) -> bool:
        """Every scheduled burst has been submitted (or shed)."""
        return self._next >= len(self.at_steps)

    def tick(self, engine, step_index: int) -> None:
        """Submit every burst whose scheduled step has arrived."""
        while (self._next < len(self.at_steps)
               and self.at_steps[self._next] <= step_index):
            i = self._next
            self._next += 1
            try:
                self.handles.append(engine.submit(
                    self.prompts[i % len(self.prompts)], self.max_new,
                    seed=self.seed + i, tenant=self.tenant))
                self.submitted += 1
            except QueueFull:
                self.handles.append(None)


class BitFlipLogits:
    """Silent-corruption injector for the serving path: XORs one bit of
    a committed token via ``Engine(token_fault_hook=...)`` — the seam
    runs where the sampled token enters the request's stream, so the
    corrupted token conditions every later decode step of that slot,
    exactly the downstream signature of corrupted logits on a bad card.
    Nothing raises and no counter trips: the ONLY way this fault is
    visible is that the bytes are wrong, which is what makes it the
    driver for the serving canary (``Engine(canary_every_s=...)``).

    ``flips`` is a ``(call, slot, bit)`` schedule: ``call`` indexes the
    injector's own monotonic count of ELIGIBLE commits (all commits, or
    only canary commits with ``canary_only=True`` — so a canary-only
    schedule is stable no matter how much real traffic interleaves),
    ``slot`` restricts to one slot (``None`` = any), ``bit`` is the bit
    to XOR.  With ``vocab`` set, a flip that would leave the vocabulary
    falls back to progressively lower bits (then ``(tok + 1) % vocab``),
    so the corrupted token is always decodable and always different.
    ``fired`` records ``(call, slot, clean, corrupt)``."""

    def __init__(self, flips, vocab: int | None = None,
                 canary_only: bool = False):
        self.flips = [(int(c), None if s is None else int(s), int(b))
                      for (c, s, b) in flips]
        for c, _, b in self.flips:
            if c < 0 or b < 0:
                raise ValueError(
                    f"call and bit must be >= 0, got ({c}, {b})")
        if vocab is not None and vocab < 2:
            raise ValueError(f"vocab must be >= 2, got {vocab}")
        self.vocab = vocab
        self.canary_only = canary_only
        self.calls = 0
        self.fired: list[tuple[int, int, int, int]] = []

    def __call__(self, slot: int, tok: int, request) -> int:
        if self.canary_only and not getattr(request, "_canary", False):
            return tok
        call = self.calls
        self.calls += 1
        for c, s, b in self.flips:
            if c != call or (s is not None and s != slot):
                continue
            for bb in (b, *range(b - 1, -1, -1)):
                corrupt = tok ^ (1 << bb)
                if self.vocab is None or 0 <= corrupt < self.vocab:
                    break
            else:
                corrupt = (tok + 1) % self.vocab
            self.fired.append((call, slot, tok, corrupt))
            return corrupt
        return tok
