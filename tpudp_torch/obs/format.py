"""The reference's per-window log lines — the port's copy of
``tpudp/obs/format.py``.  The strings are parity output: byte for byte
the reference's prints (``src/Part 2a/main.py:100-112``)."""

from __future__ import annotations


def reference_window_lines(it: int, loss: float, window_time: float,
                           log_every: int, *, fwd_t: float | None = None,
                           bwd_t: float | None = None,
                           first_window: bool = False) -> list[str]:
    """The reference's lines for one completed log window.

    ``first_window`` reproduces the reference's warm-up exclusion (the
    first window prints its loss only); ``fwd_t``/``bwd_t`` add the
    split-timing lines when the trainer measured them."""
    lines = [
        "Training loss after {} iterations is {}".format(it, loss),
    ]
    if not first_window:
        if fwd_t is not None:
            lines.append("Forward Pass time in iter {} is {}".format(
                it, fwd_t / log_every))
        if bwd_t is not None:
            lines.append("Backward Pass time in iter {} is {}".format(
                it, bwd_t / log_every))
        lines.append("Average Pass time in iter {} is {}".format(
            it, window_time / log_every))
    return lines
