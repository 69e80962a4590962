"""The per-program resource ledger — the counterpart of
``tpudp/analysis/budget.py``.

For each pinned program the audit records:

  * ``arg_bytes`` — the bytes of the program's state and inputs: every
    storage that existed before the call and that one of its operators
    reads (parameters, optimizer buffers, KV stores, batches), each
    counted once;
  * ``out_bytes`` — the bytes the call leaves behind: the storages it
    created that are still alive when it returns (its results, and
    buffers it allocates for later calls);
  * ``collective_payload_bytes`` — the bytes its collectives move (each
    call's input tensors), summed;
  * ``peak_live_bytes`` — the peak of a liveness census of the tensors
    the call creates: each new storage's bytes at its birth (the first
    operator output that holds it), released when that tensor dies.

The first three do not depend on the torch version and are compared
always; ``peak_live_bytes`` follows the operators torch dispatches, so
the audit compares it only under the lock's torch.  Tolerance bands are
JAX's (:data:`BUDGET_TOLERANCES`): a doubled buffer or a new collective
fails by program and metric.  Stdlib only.
"""

from __future__ import annotations

#: Relative tolerance a metric: ``|new - old| / max(old, 1)``.
BUDGET_TOLERANCES = {
    "peak_live_bytes": 0.10,
    "arg_bytes": 0.0,
    "out_bytes": 0.0,
    "collective_payload_bytes": 0.0,
}

#: The metrics that do not depend on the torch version.
VERSION_NEUTRAL = ("arg_bytes", "out_bytes", "collective_payload_bytes")


def compare_budgets(name: str, old: dict | None, new: dict | None,
                    metrics=tuple(BUDGET_TOLERANCES)) -> list[str]:
    """Named per-metric deltas for one program beyond their tolerance
    bands, over ``metrics``."""
    if new is None:
        return []
    if old is None:
        return [f"{name}: no budget ledger in the lock — regenerate with "
                f"`audit --update`"]
    problems = []
    for metric in metrics:
        tol = BUDGET_TOLERANCES[metric]
        a, b = old.get(metric), new.get(metric)
        if a is None or b is None or a == b:
            continue
        rel = abs(b - a) / max(abs(a), 1)
        if rel <= tol:
            continue
        sign = "+" if b > a else "-"
        problems.append(
            f"{name}: budget metric {metric} {a} -> {b} ({sign}"
            f"{rel * 100:.2g}%, tolerance {tol * 100:.0f}%) — the "
            f"program's resource ledger moved; if intended, regenerate "
            f"with `audit --update` and review the lock diff")
    return problems


def lock_has_ledgers(lock: dict) -> bool:
    """A ledger under every pinned program, and the capture geometry."""
    programs = lock.get("programs")
    return bool(lock.get("geometry") and programs
                and all("budget" in rec for rec in programs.values()))


def render_table(programs: dict) -> str:
    """The committed ledgers as a fixed-width table."""
    rows = [("program", "peak_live", "args", "outs", "coll_payload")]
    for name in sorted(programs):
        b = programs[name].get("budget") or {}
        rows.append((name, _human(b.get("peak_live_bytes")),
                     _human(b.get("arg_bytes")), _human(b.get("out_bytes")),
                     _human(b.get("collective_payload_bytes"))))
    widths = [max(len(r[i]) for r in rows) for i in range(5)]
    return "\n".join("  ".join(c.ljust(widths[i])
                               for i, c in enumerate(r)).rstrip()
                     for r in rows)


def _human(n) -> str:
    if n is None:
        return "-"
    for unit in ("B", "KiB", "MiB"):
        if abs(n) < 1024:
            return f"{n}B" if unit == "B" else f"{n:.1f}{unit}"
        n /= 1024
    return f"{n:.1f}GiB"
