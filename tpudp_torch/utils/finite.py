"""The fail-fast divergence check — the port's copy of
``tpudp/utils/watchdog.py``'s ``check_finite``."""

from __future__ import annotations

import math


def check_finite(loss_value: float, step: int | None = None, *,
                 what: str = "training loss",
                 context: str | None = None) -> float:
    """Return ``loss_value``, or raise ``FloatingPointError`` naming
    ``what``, the step and ``context`` when it is NaN or infinite."""
    if not math.isfinite(loss_value):
        where = f" at step {step}" if step is not None else ""
        if context:
            where += f" ({context})"
        raise FloatingPointError(
            f"non-finite {what}{where}: {loss_value!r} — diverged "
            "or corrupted replica")
    return loss_value
