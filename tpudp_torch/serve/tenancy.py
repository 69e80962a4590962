"""Multi-tenant admission for ``tpudp_torch.serve`` — the port of
``tpudp/serve/tenancy.py``: priority tiers, weighted fair shares and the
queue bookkeeping behind preemption.  Plain host-side Python, copied so
the port imports nothing of the JAX package; the engine consults it
between device steps.

  * **TenantClass** — one class's config: ``priority`` (higher preempts
    lower), ``queue_limit`` (per-class bounded admission, shedding with
    the engine's ``QueueFull``), ``weight`` (share among classes at
    equal priority), ``default_deadline_s`` (applied to submits without
    their own deadline) and ``model`` (the name of a co-resident model
    of ``Engine(models=...)`` the class decodes with; None = the
    engine's default model).
  * **TenantScheduler** — per-class deques and the admission policy:
    strict priority across classes (the engine preempts lower-priority
    in-flight work for a waiting higher-priority request, through its
    requeue path), and stride scheduling within a priority: each class's
    ``pass`` advances by ``1 / weight`` an admission, the minimum pass
    (then the name) is admitted, and a class that was idle re-enters at
    its tier's current virtual time, so it banks no credit while idle.
    Deterministic: no clock, no random draw.
"""

from __future__ import annotations

import collections


class TenantClass:
    """Admission class config for one tenant tier.

    ``priority``: higher values are served first and may preempt
    lower-priority in-flight work (strict across classes).
    ``queue_limit``: per-class bound on queued (not yet admitted)
    requests; submits past it shed with a typed ``QueueFull``
    (``None`` = unbounded).  ``weight``: fair-share weight among
    classes at the same priority (must be > 0).  ``default_deadline_s``:
    applied to any ``submit`` into this class that does not pass its
    own ``deadline_s``.  ``model``: name of a co-resident model
    registered via ``Engine(models={...})`` this class routes to
    (``None`` = the engine's default model)."""

    def __init__(self, priority: int = 0, queue_limit: int | None = None,
                 weight: float = 1.0,
                 default_deadline_s: float | None = None,
                 model: str | None = None):
        if queue_limit is not None and queue_limit < 1:
            raise ValueError(
                f"queue_limit must be >= 1 (or None for unbounded), "
                f"got {queue_limit}")
        if not weight > 0:
            raise ValueError(f"weight must be > 0, got {weight}")
        if default_deadline_s is not None and default_deadline_s <= 0:
            raise ValueError(f"default_deadline_s must be > 0, got "
                             f"{default_deadline_s}")
        self.priority = int(priority)
        self.queue_limit = queue_limit
        self.weight = float(weight)
        self.default_deadline_s = default_deadline_s
        self.model = model

    def __repr__(self) -> str:
        return (f"TenantClass(priority={self.priority}, "
                f"queue_limit={self.queue_limit}, weight={self.weight}, "
                f"default_deadline_s={self.default_deadline_s}, "
                f"model={self.model!r})")


class _TenantState:
    """Scheduler-internal per-class state: the bounded deque, the stride
    pass value, and the per-class stats counter the engine publishes as
    ``Engine.tenant_stats[name]``."""

    __slots__ = ("name", "cls", "queue", "pass_", "stats")

    def __init__(self, name: str, cls: TenantClass):
        self.name = name
        self.cls = cls
        self.queue: collections.deque = collections.deque()
        self.pass_ = 0.0
        self.stats = collections.Counter()


class TenantScheduler:
    """Per-class queues + the priority/stride admission policy.

    The engine owns slots, device steps, and preemption mechanics; this
    object owns WHICH queued request is admitted next and all queue
    walking (deadline expiry, cancel, drain/close must see every class,
    not just a single FIFO)."""

    def __init__(self, tenants: dict):
        if not isinstance(tenants, dict) or not tenants:
            raise ValueError(
                "tenants must be a non-empty {name: TenantClass} dict")
        self._states: dict[str, _TenantState] = {}
        for name, cls in tenants.items():
            if not isinstance(name, str) or not name:
                raise ValueError(
                    f"tenant names must be non-empty strings, got {name!r}")
            if not isinstance(cls, TenantClass):
                raise ValueError(
                    f"tenants[{name!r}] must be a TenantClass, "
                    f"got {type(cls).__name__}")
            self._states[name] = _TenantState(name, cls)
        # Stride virtual time PER priority tier: classes only ever
        # compete within their own priority, so only same-tier pops may
        # advance the clock an idle class re-enters at (a shared clock
        # inflated by high-priority traffic would starve a re-entering
        # heavyweight class behind its lighter peers).
        self._vtime: dict[int, float] = {}

    # -- lookup --------------------------------------------------------

    @property
    def names(self) -> list[str]:
        return list(self._states)

    def cls(self, name: str) -> TenantClass:
        return self._states[name].cls

    def stats(self, name: str) -> collections.Counter:
        return self._states[name].stats

    def resolve(self, tenant: str | None) -> str:
        """Map a ``submit(tenant=...)`` argument to a class name.
        ``None`` routes to the class literally named ``"default"`` when
        one exists — so drop-in callers (``generate_many``, existing
        scripts) keep working against a tenant-aware engine — and is an
        error otherwise (with classes configured, unclassed traffic is
        a routing bug, not a default)."""
        if tenant is None:
            if "default" in self._states:
                return "default"
            raise ValueError(
                f"this engine is tenant-aware (classes: "
                f"{sorted(self._states)}); pass submit(tenant=...) or "
                f"configure a class named 'default'")
        if tenant not in self._states:
            raise ValueError(f"unknown tenant {tenant!r} (classes: "
                             f"{sorted(self._states)})")
        return tenant

    # -- queue state ---------------------------------------------------

    def depth(self, name: str | None = None) -> int:
        if name is not None:
            return len(self._states[name].queue)
        return sum(len(ts.queue) for ts in self._states.values())

    def full(self, name: str) -> bool:
        ts = self._states[name]
        return (ts.cls.queue_limit is not None
                and len(ts.queue) >= ts.cls.queue_limit)

    def queued(self) -> list:
        """Snapshot of every queued request across all classes (class
        registration order, FIFO within a class) — the iteration surface
        for deadline expiry and drain/close walks."""
        out = []
        for ts in self._states.values():
            out.extend(ts.queue)
        return out

    def waiting_by_priority(self) -> list[tuple[int, int]]:
        """``(priority, queued_count)`` pairs, highest priority first —
        the engine's preemption scan input."""
        counts: collections.Counter = collections.Counter()
        for ts in self._states.values():
            if ts.queue:
                counts[ts.cls.priority] += len(ts.queue)
        return sorted(counts.items(), key=lambda kv: -kv[0])

    # -- mutation ------------------------------------------------------

    def enqueue(self, request) -> None:
        """Tail-append a fresh submit.  A class whose queue was empty
        re-enters the stride race at its own tier's current virtual
        time — idleness must not bank credit."""
        ts = self._states[request.tenant]
        if not ts.queue:
            ts.pass_ = max(ts.pass_,
                           self._vtime.get(ts.cls.priority, 0.0))
        ts.queue.append(request)

    def requeue_front(self, request) -> None:
        """Head-insert previously ADMITTED work (preemption, step-
        failure requeue): it was already accepted and partially served,
        so it goes before its class's fresh submits and never re-pays
        queue limits — nor the stride charge (marked ``_readmit``; its
        class paid at first admission, and charging resumes again would
        make a preempted class pay twice for one request, skewing the
        measured shares away from the configured weights exactly when
        preemption pressure concentrates on the heavier class)."""
        request._readmit = True
        self._states[request.tenant].queue.appendleft(request)

    def remove(self, request) -> None:
        self._states[request.tenant].queue.remove(request)

    def pop_next(self):
        """The admission policy: highest priority class with queued
        work; stride (min pass, then name) among equals; FIFO within
        the class.  Resumed work (see :meth:`requeue_front`) pops free —
        no pass advance, no vtime update — because its class was
        charged when it was first admitted.  Returns None when nothing
        is queued."""
        cands = [ts for ts in self._states.values() if ts.queue]
        if not cands:
            return None
        top = max(ts.cls.priority for ts in cands)
        ts = min((t for t in cands if t.cls.priority == top),
                 key=lambda t: (t.pass_, t.name))
        req = ts.queue.popleft()
        if getattr(req, "_readmit", False):
            req._readmit = False
        else:
            self._vtime[top] = ts.pass_
            ts.pass_ += 1.0 / ts.cls.weight
        return req

    def drain_all(self) -> list:
        """Pop and return every queued request across all classes (for
        ``Engine.close()`` — each must get a terminal finish_reason; no
        handle may be left pending in a forgotten per-class deque)."""
        out = []
        for ts in self._states.values():
            while ts.queue:
                out.append(ts.queue.popleft())
        return out
