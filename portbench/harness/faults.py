"""Faults planted under a run, to show that its comparison catches them.

Only the tests and ``portbench/calibrate.py`` plant them; a run of
``run.py`` never does.

* ``unchanged``: the step returns its state as it was (a zero loss);
* ``half_batch``: the step sees the first half of its batch, the mean
  taken over that half;
* ``altered_batch``: one value of each batch the data layer produces is
  changed before the step sees it.
"""

from __future__ import annotations

import torch


def wrap_step(fault: str | None, step):
    """``step`` with ``fault`` planted (as it is for the others)."""
    if fault == "unchanged":
        def unchanged(state, inputs, targets):
            return state, torch.zeros((), device=inputs.device)
        return unchanged
    if fault == "half_batch":
        def half(state, inputs, targets):
            n = inputs.shape[0] // 2
            return step(state, inputs[:n], targets[:n])
        return half
    return step


def alter_batch(fault: str | None, batch: tuple) -> tuple:
    """A data layer's batch ``(images, labels, ...)`` with ``fault``
    planted: under ``altered_batch`` one value of the images changed."""
    if fault != "altered_batch":
        return batch
    images = batch[0].clone()
    images.view(-1)[0] += 1.0
    return (images, *batch[1:])
